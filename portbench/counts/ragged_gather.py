"""Kernel 2 (``csrc/ragged_gather.cu``) fetching rows' neighbor ids from
the CSR: the hub rows' in the hub lane, every row's in the CSR lane (no
dense table, no store).  Each real row's ids read once and written once,
as int32; not the padded window or chunk the lane fetches."""

KERNEL = "ragged_gather_kernel"


def id_bytes(degree_sum: int) -> int:
    """Bytes of the ids of rows whose degrees sum to ``degree_sum``, read
    and written."""
    return 2 * 4 * degree_sum
