"""PC-GNN's training step's least work (the ``pcgnn`` reference's count).

Bytes, each input read once and each output written once, at the stored
width: the batch's fused records (bfloat16, the windows of every
relation) or, in a lane with no store, each real row's neighbors in every
relation (float32 feature row and int32 id), the batch's ids and labels
(int64) and weights (float32), the centers' feature rows (float32), the
train positives' feature rows that the oversample scores, every hub row's
neighbors that the choose step scores (feature row and id), and the
parameters and Adam's two moments, read and written (float32).
Operations: the dense layers, forward, and backward as far as a gradient
is needed (no gradient reaches the features or the aggregates)."""


def byte_terms(*, rows: int, steps: int, feat_dim: int, record_width: int,
               train_pos: int, hub_neighbors: int, params: int,
               neighbors: int | None = None) -> dict:
    """Bytes by term, over ``rows`` real batch rows in ``steps`` steps;
    ``hub_neighbors`` is the degree sum of the hub rows among them.  A lane
    with no store gives ``neighbors``, the degree sum of all of them over
    every relation: its rows and ids take the records' place (the hub
    rows' stay with ``hub_neighbor_rows``)."""
    f = feat_dim
    terms = {
        "records": rows * record_width * 2,
        "ids_labels_weights": rows * (8 + 8 + 4),
        "center_rows": rows * f * 4,
        "train_pos_rows": steps * train_pos * f * 4,
        "hub_neighbor_rows": hub_neighbors * (f * 4 + 4),
        "params_and_moments": steps * params * 4 * 6,
    }
    if neighbors is not None:
        del terms["records"]
        terms["neighbor_rows"] = (neighbors - hub_neighbors) * (f * 4 + 4)
    return terms


def flops(*, rows: int, feat_dim: int, emb: int, relations: int,
          classes: int = 2) -> int:
    """Dense-layer operations of ``rows`` batch rows, forward and
    backward."""
    f, e, r, c = feat_dim, emb, relations, classes
    fwd = 2 * (f * c + r * 2 * f * e + (f + r * e) * e + e * c)
    weight_grads = fwd
    input_grads = 2 * (e * c + r * e * e)   # into z, and into each h_r
    return rows * (fwd + weight_grads + input_grads)


def count(t: dict) -> tuple:
    """(bytes by term, operations) of the traced slice's record ``t``."""
    terms = byte_terms(
        rows=t["rows"], steps=t["steps"], feat_dim=t["feat_dim"],
        record_width=t["record_width"], train_pos=t["train_pos"],
        hub_neighbors=t["hub_neighbors"], params=t["params"],
        neighbors=None if t["stores"] else t["neighbors"])
    return terms, flops(rows=t["rows"], feat_dim=t["feat_dim"],
                        emb=t["emb"], relations=t["relations"])
