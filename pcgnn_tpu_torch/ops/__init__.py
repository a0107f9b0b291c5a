"""The ops the JAX package's ``pcgnn_tpu.ops`` exports, from their port
modules."""

from pcgnn_tpu_torch.ops.aggregate import (  # noqa: F401
    batch_neighbor_window,
    choose_keep_mask,
    dedup_minor_keep,
    masked_mean_aggregate,
    oversample_candidates,
    oversample_keep,
    row_ranks,
    scatter_batch_mask,
    segment_mean_spmm,
    union_self_window,
    window_mean_aggregate,
)
from pcgnn_tpu_torch.ops.sddmm import (  # noqa: F401
    edge_abs_diff,
    edge_ranks_global,
)
