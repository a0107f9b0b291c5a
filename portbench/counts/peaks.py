"""Published peaks of the cards the benchmark knows, by a part of the name
``torch.cuda.get_device_name`` gives (NVIDIA's data sheets, full power
limit): (memory bytes/s, float32 FLOP/s without the tensor cores).  The
configurations compute in float32 with TF32 off, so their products run
at the float32 rate, not the tensor cores' rate."""

PEAKS = (
    ("H200", (4.8e12, 67e12)),
    ("H100 PCIe", (2.0e12, 51e12)),
    ("H100 NVL", (3.9e12, 60e12)),
    ("H100", (3.35e12, 67e12)),         # SXM: "NVIDIA H100 80GB HBM3"
)


def peaks(kind: str):
    """(bytes/s, FLOP/s) of the card named ``kind``; None when unknown."""
    for part, p in PEAKS:
        if part in kind:
            return p
    return None
