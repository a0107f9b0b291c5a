"""Kernel 1 (``csrc/window_gather.cu``) fetching the batch's fused
records: its copy bound, the records read once and written once at the
store's width (bfloat16).  The kernel writes them widened to float32, so
a fetch that fuses the widening away still reads at or under 100%."""

KERNEL = "window_gather_kernel"


def copy_bytes(rows: int, width: int, elem_bytes: int = 2) -> int:
    """Bytes of ``rows`` records of ``width`` elements, read and written."""
    return 2 * rows * width * elem_bytes
