from pcgnn_tpu_torch.models.gcn import GCN
from pcgnn_tpu_torch.models.graphsage import GraphSage
from pcgnn_tpu_torch.models.pcgnn import PCGNN


def build_model(name: str, **kwargs):
    """Model registry, with the JAX package's names and keyword arguments:
    ``PCGNN(feat_dim, emb_dim, num_relations, alpha, rho, ...)``,
    ``GCN(feat_dim, emb_dim)`` and ``SAGE``, ``GraphSage(feat_dim, emb_dim,
    num_sample=...)``; each also takes a ``torch.Generator`` for its
    initial weights."""
    name = name.upper()
    if name == "PCGNN":
        return PCGNN(**kwargs)
    if name == "GCN":
        return GCN(**kwargs)
    if name == "SAGE":
        return GraphSage(**kwargs)
    raise ValueError(f"unknown model {name!r} (expected PCGNN, GCN, or SAGE)")
