from pcgnn_tpu_torch.models.pcgnn import PCGNN


def build_model(name: str, **kwargs):
    """Model registry.  The port has PC-GNN only so far; the GraphSAGE and
    GCN baselines are ROADMAP module 9."""
    name = name.upper()
    if name == "PCGNN":
        return PCGNN(**kwargs)
    if name in ("GCN", "SAGE"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP module 9: GraphSAGE "
            f"and GCN baselines)")
    raise ValueError(f"unknown model {name!r} (expected PCGNN, GCN, or SAGE)")
