"""The GCN baseline's training step's least work (the ``gcn`` reference's
count).

Bytes, each input read once and each output written once, at the stored
width: the batch's homo windows (bfloat16, the window kernel 1 gives each
real row, as PC-GNN's count takes the fused records) or, in a lane with
no store, each real row's homo neighbors (float32 feature row and int32
id); every hub row's neighbors (feature row and id); the centers' feature
rows (float32); the batch's ids and labels (int64) and weights
(float32); and the parameters and Adam's two moments, read and written
(float32).  Operations: the forward's F x E and E x C products, their
weight gradients, and the input gradient into the embedding; no gradient
reaches the aggregate."""


def byte_terms(*, rows: int, steps: int, feat_dim: int, record_width: int,
               hub_neighbors: int, params: int,
               neighbors: int | None = None) -> dict:
    """Bytes by term, over ``rows`` real batch rows in ``steps`` steps;
    ``record_width`` is the homo window's elements a row, ``hub_neighbors``
    the degree sum of the hub rows among them.  A lane with no store gives
    ``neighbors``, the degree sum of all of them: their rows and ids take
    the windows' place."""
    f = feat_dim
    terms = {
        "windows": rows * record_width * 2,
        "hub_neighbor_rows": hub_neighbors * (f * 4 + 4),
        "center_rows": rows * f * 4,
        "ids_labels_weights": rows * (8 + 8 + 4),
        "params_and_moments": steps * params * 4 * 6,
    }
    if neighbors is not None:
        del terms["windows"]
        terms["neighbor_rows"] = (neighbors - hub_neighbors) * (f * 4 + 4)
    return terms


def flops(*, rows: int, feat_dim: int, emb: int, classes: int = 2) -> int:
    """Operations of ``rows`` batch rows, forward and backward."""
    f, e, c = feat_dim, emb, classes
    fwd = 2 * (f * e + e * c)
    weight_grads = fwd
    input_grads = 2 * e * c                 # into z
    return rows * (fwd + weight_grads + input_grads)


def count(t: dict) -> tuple:
    """(bytes by term, operations) of the traced slice's record ``t``."""
    terms = byte_terms(
        rows=t["rows"], steps=t["steps"], feat_dim=t["feat_dim"],
        record_width=t["record_width"], hub_neighbors=t["hub_neighbors"],
        params=t["params"], neighbors=None if t["stores"] else t["neighbors"])
    return terms, flops(rows=t["rows"], feat_dim=t["feat_dim"], emb=t["emb"])
