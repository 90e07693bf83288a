"""The peaks every roofline and MFU divides by: one NVIDIA H100 SXM at its
700 W limit (NVIDIA's data sheet, dense rates).  A product in any
precision is held to the dense bf16 tensor-core rate, the highest any
implementation of it could use, so that no implementation reads over
100%."""

FLOPS = 989e12          # dense bf16 tensor-core operations a second
BYTES = 3.35e12         # HBM3 bytes a second


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work: the larger of its
    operations over FLOPS and its bytes over BYTES."""
    return max(flops / FLOPS, nbytes / BYTES)
