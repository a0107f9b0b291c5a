"""Dataset loading.

The port loads the generated ``synthetic:*`` graphs so far; the reference's
file formats (pickled adjacency lists, kdk ``.npz`` networks, the native
``.npz``) are ROADMAP module 12.
"""

from __future__ import annotations

from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.graph.csr import MultiRelGraph

# number of leading unlabeled node ids per dataset
NUM_UNLABELED = {"amazon": 3305, "amazon_new": 2013}


def load_data(name: str, prefix: str = "data/", *,
              threshold: float | list = 0.5, graph_id=None, seed: int = 0,
              device="cpu") -> MultiRelGraph:
    """``threshold`` may be one float or a per-relation list."""
    if name.startswith("synthetic"):
        preset = name.split(":", 1)[1] if ":" in name else "small"
        return synthetic_fraud_graph(preset, seed=seed, threshold=threshold,
                                     device=device)
    raise NotImplementedError(
        f"dataset {name!r}: only synthetic:* graphs load in the port so far "
        f"(ROADMAP module 12: real-file loaders)")
