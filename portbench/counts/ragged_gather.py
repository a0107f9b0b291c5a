"""Kernel 2 (``csrc/ragged_gather.cu``) fetching the hub rows' neighbor
ids: each real hub row's ids read once and written once, as int32; not
the padded chunk the lane fetches."""

KERNEL = "ragged_gather_kernel"


def id_bytes(hub_degree_sum: int) -> int:
    """Bytes of the ids of hub rows whose degrees sum to
    ``hub_degree_sum``, read and written."""
    return 2 * 4 * hub_degree_sum
