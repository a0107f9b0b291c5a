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

Matrix products go through ``mm``: float32, or, for the control, each
operand, the backward's too, rounded to TF32 first (10 mantissa bits, to
nearest), which is what a TF32 product on the card computes; the
aggregates' sums of gathered rows round those rows to TF32 for it too.
The aggregates gather the rows they sum, so their memory follows the
batch, its widest row and the train positives, not the node count.

The harness reaches a reference only through its module's interface, the
functions under "Interface" at the end of this file (``reference/__init__``).
"""

from __future__ import annotations

import torch

from portbench.reference import graph as refgraph
from portbench.reference import weights as init_weights

# the precision of Adam's bias corrections: float32, as the card's
# capturable Adam computes them (on the CPU, torch's Adam takes them in
# float64: the CPU tests set this)
BIAS_CORRECTION_DTYPE = torch.float32


def tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` (float32) rounded to TF32's 10 mantissa bits, ties away from
    zero, as the card converts an operand."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` with every operand, the backward's too, in TF32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(b).T, tf32(a).T @ g


def mm(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    return _TF32Product.apply(a, b) if low else a @ b


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


def _row_sum(g, ids: torch.Tensor, take: torch.Tensor, exact, low: bool,
             budget: int = 1 << 24) -> torch.Tensor:
    """[B, F] sum over each row's taken ``ids`` of their feature rows:
    exact where ``exact`` [B] (everywhere when None), else the stored
    ones; in blocks of rows of about ``budget`` gathered elements."""
    b, k = ids.shape
    f = g.features.shape[1]
    step = max(1, budget // max(k * f, 1))
    out = [g.features.new_zeros((0, f))]
    for i in range(0, b, step):
        sl = slice(i, i + step)
        rows = g.features[ids[sl]]
        if exact is not None and g.stored is not g.features:
            rows = torch.where(exact[sl, None, None], rows,
                               g.stored[ids[sl]])
        if low:
            rows = tf32(rows)
        out.append(torch.where(take[sl, :, None], rows, 0.0).sum(1))
    return torch.cat(out)


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
    num = _row_sum(g, kept_ids, kept, deg > rel.dcap, low)
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
        num = num + _row_sum(g, minor_ids, minor, None, low)
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


def _ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -torch.log_softmax(logits, dim=1).gather(1, y[:, None])[:, 0]


def loss(g, params: dict, nodes, weights, alpha: float, rho: float,
         low: bool = False) -> torch.Tensor:
    y = g.labels[nodes]
    logits, label_scores = forward(g, params, nodes, y, rho, low)
    denom = weights.sum().clamp(min=1.0)
    return ((_ce(logits, y) * weights).sum() / denom
            + alpha * (_ce(label_scores, y) * weights).sum() / denom)


def train_steps(g, params0: dict, batches, weights, *, lr: float,
                weight_decay: float, alpha: float, rho: float,
                low: bool = False) -> dict:
    """Adam steps, one a row of ``batches`` / ``weights``, from
    ``params0``.  Returns the losses, the first step's gradient with the
    weight decay added (what Adam's moments take), and the parameters
    after the last step."""
    p = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    # 1 - 0.999 is 1.3e-5 off in float32, which moves every update by
    # 6e-6: the bias corrections are taken as the program's Adam takes them
    f32 = lambda x: torch.tensor(x, dtype=BIAS_CORRECTION_DTYPE)
    losses, first_grad = [], None
    for t, (nodes, w) in enumerate(zip(batches, weights), start=1):
        leaves = {k: x.clone().requires_grad_(True) for k, x in p.items()}
        lv = loss(g, leaves, nodes, w, alpha, rho, low)
        grads = torch.autograd.grad(lv, list(leaves.values()))
        losses.append(float(lv.detach()))
        with torch.no_grad():
            step = {}
            for (k, x), gr in zip(p.items(), grads):
                gd = gr + weight_decay * x
                step[k] = gd
                m[k] = b1 * m[k] + (1 - b1) * gd
                v2[k] = b2 * v2[k] + (1 - b2) * gd * gd
                bc1 = float(1 - f32(b1) ** t)
                bc2 = float(1 - f32(b2) ** t)
                denom = v2[k].sqrt() / bc2 ** 0.5 + eps
                p[k] = x - (lr / bc1) * m[k] / denom
            if first_grad is None:
                first_grad = step
    return {"losses": losses, "grad": first_grad, "params": p}


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
