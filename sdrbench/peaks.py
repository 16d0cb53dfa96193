"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
700 W limit): what a roofline share is taken against."""

FP32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # HBM3


def least_seconds(operations: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the float32 peak and the bytes at the memory peak."""
    return max(operations / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
